"""Merge-tree range query — the ``executor='kernel'`` tier of static RFS.

The paper's Algorithm 2 (DualDetect) over the time-major merge-tree tables
of the flat forest: per (edge group g, atom slot q, half-window w),
canonically decompose the edge's time-rank interval [r_lo, r_hi) into ≤ 2
buckets per level (level ℓ buckets 2^ℓ consecutive time ranks; inside a
bucket the events are position-sorted and carry inclusive prefix moments),
rank the atom's three position bounds inside each emitted bucket, and dot
the prefix-moment difference with the slot's query vector. Levels ascend,
the left bucket of a level comes before the right one.

``csrc/tree_query.cu`` is the kernel. It replaces the TPU kernel
``repro.kernels.tree_query.tree_query_pallas``. It reads the flat forest as
it is: ``pos_flat [T]`` (+inf padded) and ``cum_flat [T, 4K]`` with
``K = k_s·k_t``; the edge of group g owns rows ``base[g] + lev·npad + i``
(every edge of a launch has the same ``npad`` and ``npad.bit_length()``
levels). Rank intervals are per edge, ``r_lo/r_hi [G, Wh]``; the position
bounds ``pos_hi/pos_lo1/lo1_right/pos_lo2``, the masked ``qs [G, Q, k_s]``
and ``side [G, Q]`` per slot; ``qt [Wh, k_t]`` and ``half [Wh]`` per
half-window. The query vector is built where it is used: the slot's combo
``c = side·2 + half[w]`` selects the K columns ``c·K + s·k_t + t`` of a
prefix row, weighted by ``qs[s]·qt[t]`` (one product, s-major) — the other
three combos of the reference's one-hot ``q_vec [G, Wh, Q, 4K]`` contribute
only ±0, so the result is that of the ``q_vec`` form up to the sign of a
zero. Output ``[G, Q, Wh]``: slot-major, so the two halves of window w are
columns 2w and 2w+1 of ``out.reshape(G·Q, Wh)``.

Where the Pallas body ranks a bound by a masked compare-count over the whole
row (the TPU has no cheap gather), the kernel and :func:`tree_query_ref` run
a branch-free binary search over the bucket's segment: each segment is
sorted with its +inf padding at the end, so the search returns the same
count.

This module holds the plain PyTorch version, :func:`tree_query_ref` — what
a CPU tensor gets and what the kernel is compared with on the card — the
bucket enumeration it shares with the bound of ``chip_smoke.py``
(:func:`tree_buckets`, over the per-group views :func:`tree_query_views`
gathers), and the ``ctypes`` binding of the compiled kernel. The launching
wrapper is :func:`repro_torch.kernels.ops.tree_query`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["tree_buckets", "tree_query_library", "tree_query_ref", "tree_query_views"]


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

    Over per-group views (:func:`tree_query_views`): ``pos [G, LVL, NPAD]``
    and ``r_lo/r_hi [G, Wh, Q]``. Yields ``(lev, lane, g, seg_lo, i_lo,
    i_hi)`` per (level, side), left side first, for the lanes that emit a
    bucket there: ``lane`` their flat index into [G, Wh, Q], ``g`` their
    edge group, the bucket's segment start in the level row and the
    position-selected interval [i_lo, i_hi) of the segment (absolute indices
    in the level row). Lanes that emit nothing are skipped, not masked: the
    values are the same, the work is not.
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


def tree_query_views(pos_flat, base, r_lo, r_hi, Q: int, *, npad: int):
    """Per-group views of the kernel's inputs, for :func:`tree_buckets`:
    ``pos [G, LVL, NPAD]`` gathered from the flat forest (a copy) and the
    rank intervals broadcast to ``[G, Wh, Q]`` (views)."""
    G, Wh = r_lo.shape
    lvl = int(npad).bit_length()
    idx = base[:, None] + torch.arange(lvl * npad, device=base.device)
    pos = pos_flat[idx].reshape(G, lvl, npad)
    return pos, r_lo[:, :, None].expand(G, Wh, Q), r_hi[:, :, None].expand(G, Wh, Q)


def tree_query_ref(
    pos_flat: torch.Tensor,  # [T] position-sorted bucket tables (+inf pad)
    cum_flat: torch.Tensor,  # [T, 4K] inclusive per-bucket prefix moments
    base: torch.Tensor,  # [G] i64 first row of each group's edge block
    r_lo: torch.Tensor,  # [G, Wh] per-half-window time-rank interval lo
    r_hi: torch.Tensor,  # [G, Wh]
    pos_hi: torch.Tensor,  # [G, Q] upper position bound (inclusive)
    pos_lo1: torch.Tensor,  # [G, Q] lower bound 1
    lo1_right: torch.Tensor,  # [G, Q] nonzero: lower bound 1 is exclusive
    pos_lo2: torch.Tensor,  # [G, Q] lower bound 2 (inclusive)
    qs: torch.Tensor,  # [G, Q, k_s] spatial coefficients (padding slots zero)
    qt: torch.Tensor,  # [Wh, k_t] temporal coefficients
    side: torch.Tensor,  # [G, Q] i32 event-feature side of the slot
    half: torch.Tensor,  # [Wh] i32 0 = left half-window, 1 = right
    *,
    npad: int,  # padded event count of every edge of the launch
) -> torch.Tensor:
    """Window-batched merge-tree range query: [G, Q, Wh]. Plain PyTorch; the
    torch transcription of ``repro.kernels.ref.tree_query`` in the kernel's
    association: per emitted bucket ``Σ_k (qs[s]·qt[t])·(hi[k] − lo[k])``
    over the slot's combo columns ``k = s·k_t + t`` in order, added to the
    lane's sum left bucket before right, levels ascending."""
    G, Q = pos_hi.shape
    Wh = r_lo.shape[1]
    ks, kt = qs.shape[2], qt.shape[1]
    K = ks * kt
    T = cum_flat.shape[0]
    pos, rl, rh = tree_query_views(pos_flat, base, r_lo, r_hi, Q, npad=npad)
    acc = torch.zeros(G * Wh * Q, dtype=cum_flat.dtype, device=cum_flat.device)
    kcol = torch.arange(K, device=cum_flat.device)
    for lev, lane, g, seg_lo, i_lo, i_hi in tree_buckets(pos, rl, rh, pos_hi, pos_lo1,
                                                         lo1_right, pos_lo2):
        w, q = (lane // Q) % Wh, lane % Q
        cols = ((side[g, q].to(torch.int64) * 2 + half[w].to(torch.int64)) * K)[:, None] + kcol
        row0 = base[g] + lev * npad - 1

        def pref(i):
            rows = cum_flat[(row0 + i).clamp(0, T - 1)[:, None], cols]  # [n, K]
            return torch.where((i > seg_lo)[:, None], rows, 0.0)

        mom = (pref(i_hi) - pref(i_lo)).T.contiguous()  # [K, n]: contiguous k slabs
        qv = (qs[g, q][:, :, None] * qt[w][:, None, :]).reshape(-1, K).T.contiguous()
        d = qv[0] * mom[0]
        for k in range(1, K):
            d = d + qv[k] * mom[k]
        acc[lane] = acc[lane] + d
    return acc.reshape(G, Wh, Q).permute(0, 2, 1).contiguous()


def tree_query_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/tree_query.cu``, built at first use, with the
    argument types of ``tree_query_f64`` set (pointers and the stream are
    ``c_void_p``: ctypes would otherwise cut them to 32 bits)."""
    from ._build import load_library

    lib = load_library("tree_query", verbose=verbose)
    fn = lib.tree_query_f64
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 8 + [p]
        fn.restype = i
    return lib
