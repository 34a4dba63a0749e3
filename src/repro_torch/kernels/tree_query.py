"""Merge-tree range query — the ``executor='kernel'`` tier of static RFS.

The paper's Algorithm 2 (DualDetect) over per-edge grouped TIME-major
merge-tree tables: per (edge group g, half-window w, atom slot q),
canonically decompose the time-rank interval [r_lo, r_hi) into ≤ 2 buckets
per level (level ℓ buckets 2^ℓ consecutive time ranks; inside a bucket the
events are position-sorted and carry inclusive prefix moments), rank the
atom's three position bounds inside each emitted bucket, and dot the
prefix-moment difference with the slot's query vector. Levels ascend, the
left bucket of a level comes before the right one.

``csrc/tree_query.cu`` is the kernel. It replaces the TPU kernel
``repro.kernels.tree_query.tree_query_pallas`` and keeps its contract:
``pos [G, LVL, NPAD]`` (+inf padded), ``cum [G, LVL, NPAD, K4]``,
``r_lo/r_hi [G, Wh, Q]``, ``pos_hi/pos_lo1/pos_lo2 [G, Q]``,
``lo1_right [G, Q]``, ``q_vec [G, Wh, Q, K4]`` in, ``[G, Wh, Q]`` out. Where
the Pallas body ranks a bound by a masked compare-count over the whole row
(the TPU has no cheap gather), the kernel and :func:`tree_query_ref` run a
branch-free binary search of ``max(NPAD.bit_length(), 1)`` trips over the
bucket's segment: each segment is sorted with its +inf padding at the end,
so the search returns the same count.

This module holds the plain PyTorch version, :func:`tree_query_ref` — what
a CPU tensor gets and what the kernel is compared with on the card — the
bucket enumeration it shares with the bound of ``chip_smoke.py``
(:func:`tree_buckets`), and the ``ctypes`` binding of the compiled kernel.
The launching wrapper is :func:`repro_torch.kernels.ops.tree_query`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["tree_buckets", "tree_query_library", "tree_query_ref"]


def _search(row, g, lo, hi, val, right, steps: int):
    """Branch-free binary search of val[n] in row[g[n], lo[n]:hi[n]]
    (ascending): the insertion point, after equal values where ``right``.
    A finished lane (lo == hi) keeps its state; its load is clamped."""
    npad = row.shape[1]
    lo, hi = lo.clone(), hi.clone()
    for _ in range(steps):
        live = lo < hi
        m = (lo + hi) >> 1
        v = row[g, m.clamp(0, npad - 1)]
        go = torch.where(right, v <= val, v < val) & live
        lo, hi = torch.where(go, m + 1, lo), torch.where(go | ~live, hi, m)
    return lo


def tree_buckets(pos, r_lo, r_hi, pos_hi, pos_lo1, lo1_right, pos_lo2):
    """The buckets the canonical decomposition emits, in the kernel's order.

    Yields ``(lev, lane, g, seg_lo, i_lo, i_hi)`` per (level, side), left
    side first, for the lanes that emit a bucket there: ``lane`` their flat
    index into [G, Wh, Q], ``g`` their edge group, the bucket's segment start
    in the level row and the position-selected interval [i_lo, i_hi) of the
    segment (absolute indices in the level row). Lanes that emit nothing are
    skipped, not masked: the values are the same, the work is not.
    """
    G, LVL, NPAD = pos.shape
    Wh, Q = r_lo.shape[1], r_lo.shape[2]
    steps = max(int(NPAD).bit_length(), 1)
    l = r_lo.reshape(-1).to(torch.int64)
    r = r_hi.reshape(-1).to(torch.int64)
    lanes = torch.arange(l.shape[0], device=pos.device)
    g_of, q_of = lanes // (Wh * Q), lanes % Q
    yes = torch.ones((), dtype=torch.bool, device=pos.device)
    for lev in range(LVL):
        row = pos[:, lev]  # [G, NPAD]
        for left in (True, False):
            lane = torch.nonzero((l < r) & (((l if left else r) & 1) == 1)).reshape(-1)
            g, q = g_of[lane], q_of[lane]
            seg_lo = (l[lane] if left else r[lane] - 1) << lev
            seg_hi = (seg_lo + (1 << lev)).clamp_max(NPAD)
            i_hi = _search(row, g, seg_lo, seg_hi, pos_hi[g, q], yes, steps)
            i_l1 = _search(row, g, seg_lo, seg_hi, pos_lo1[g, q], lo1_right[g, q] != 0, steps)
            i_l2 = _search(row, g, seg_lo, seg_hi, pos_lo2[g, q], ~yes, steps)
            i_lo = torch.maximum(i_l1, i_l2)
            yield lev, lane, g, seg_lo, i_lo, torch.maximum(i_hi, i_lo)
            if left:
                l[lane] += 1
            else:
                r[lane] -= 1
        l, r = l >> 1, r >> 1


def tree_query_ref(
    pos: torch.Tensor,  # [G, LVL, NPAD] position-sorted bucket tables (+inf pad)
    cum: torch.Tensor,  # [G, LVL, NPAD, K4] inclusive per-bucket prefix moments
    r_lo: torch.Tensor,  # [G, Wh, Q] per-half-window time-rank interval lo
    r_hi: torch.Tensor,  # [G, Wh, Q]
    pos_hi: torch.Tensor,  # [G, Q] upper position bound (inclusive)
    pos_lo1: torch.Tensor,  # [G, Q] lower bound 1
    lo1_right: torch.Tensor,  # [G, Q] nonzero: lower bound 1 is exclusive
    pos_lo2: torch.Tensor,  # [G, Q] lower bound 2 (inclusive)
    q_vec: torch.Tensor,  # [G, Wh, Q, K4] query coefficient vectors
) -> torch.Tensor:
    """Window-batched merge-tree range query: [G, Wh, Q]. Plain PyTorch; the
    torch transcription of ``repro.kernels.ref.tree_query`` in the kernel's
    association: per emitted bucket ``Σ_k q_vec[k]·(hi[k] − lo[k])`` in k
    order, added to the lane's sum left bucket before right, levels
    ascending."""
    NPAD, K4 = pos.shape[2], cum.shape[-1]
    acc = torch.zeros(r_lo.numel(), dtype=cum.dtype, device=cum.device)
    q_flat = q_vec.reshape(-1, K4)
    for lev, lane, g, seg_lo, i_lo, i_hi in tree_buckets(pos, r_lo, r_hi, pos_hi, pos_lo1,
                                                         lo1_right, pos_lo2):
        c = cum[:, lev]  # [G, NPAD, K4]

        def pref(i):
            rows = c[g, (i - 1).clamp(0, NPAD - 1)]  # [n, K4]
            return torch.where((i > seg_lo)[:, None], rows, 0.0)

        mom = (pref(i_hi) - pref(i_lo)).T.contiguous()  # [K4, n]: contiguous k slabs
        qv = q_flat[lane].T.contiguous()
        d = qv[0] * mom[0]
        for k in range(1, K4):
            d = d + qv[k] * mom[k]
        acc[lane] = acc[lane] + d
    return acc.reshape(r_lo.shape)


def tree_query_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/tree_query.cu``, built at first use, with the
    argument types of ``tree_query_f64`` set (pointers and the stream are
    ``c_void_p``: ctypes would otherwise cut them to 32 bits)."""
    from ._build import load_library

    lib = load_library("tree_query", verbose=verbose)
    fn = lib.tree_query_f64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 7 + [p]
        fn.restype = i
    return lib
