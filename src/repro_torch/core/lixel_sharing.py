"""Lixel Sharing (paper §6): share KDE work across a whole edge of lixels.

Three parts, all vectorized over the candidate edges of one query edge:

1. ``classify_candidates`` — split candidates into *dominated-at-v_c*,
   *dominated-at-v_d*, *out-of-bandwidth* and *normal* (§6.1, Eq. 6 + §6.3).
   Conditions are evaluated with vectorized min/max over the lixels; the
   paper's Lemma 6.1 (max of d(q,v_c)-d(q,v_d) attained at <= 4 break
   positions) is provided as ``lemma61_argmax`` and property-tested against
   the vectorized result.
2. ``dominated_contribution`` — for a dominated edge every lixel sees the
   same aggregated vector (the root node, O(1) via ``dominated_moments``), so
   F_e(q_i) = Q_s(d(q_i, v_side)) · M:
     * triangular spatial kernel: F is *linear* in d(q_i, v_side), which is
       two arithmetic progressions in i → two updates on the second-order
       difference array Δ² (§6.2, Figure 12). Paper-faithful path.
     * any other kernel: F is a closed form of d(q_i, v_side); evaluated
       directly, still O(l_a · k_s), no index queries (generalizes LS beyond
       the polynomial case).
3. ``recover_from_diff2`` — F = cumsum(cumsum(Δ²)) (§6.2).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .aggregation import MomentContext
from .plan import EdgeGeometry

__all__ = [
    "classify_candidates",
    "lemma61_argmax",
    "add_arithmetic",
    "dominated_contribution",
    "dominated_sweep",
    "recover_from_diff2",
]


def classify_candidates(
    geom: EdgeGeometry,
    ctx: MomentContext,
    ev_min_pos: np.ndarray,
    ev_max_pos: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Masks over geom.cand: (dom_c, dom_d, out, normal), mutually exclusive.

    ev_min_pos / ev_max_pos: per-network-edge min/max event position
    (conservative, window-independent — matches the paper's use of the
    whole edge / all events as the worst case).
    """
    nc = geom.cand.shape[0]
    if nc == 0:
        z = np.zeros(0, bool)
        return z, z, z, z
    b_s = ctx.b_s
    len_e = geom.len_e
    max_dc = geom.d_c.max(axis=0)
    max_dd = geom.d_d.max(axis=0)
    min_dc = geom.d_c.min(axis=0)
    min_dd = geom.d_d.min(axis=0)
    diff_cd_max = (geom.d_c - geom.d_d).max(axis=0)
    diff_dc_max = (geom.d_d - geom.d_c).max(axis=0)
    mx = ev_max_pos[geom.cand]
    mn = ev_min_pos[geom.cand]
    # Eq. 6: every lixel reaches every event through v_c, all within b_s
    dom_c = (max_dc + len_e <= b_s) & (diff_cd_max <= len_e - 2.0 * mx)
    dom_d = (max_dd + len_e <= b_s) & (diff_dc_max <= 2.0 * mn - len_e)
    dom_d &= ~dom_c
    # §6.3: even from the nearest endpoint with d(v, p) = 0 nothing is in range
    out = (min_dc > b_s) & (min_dd > b_s) & ~dom_c & ~dom_d
    normal = ~(dom_c | dom_d | out)
    return dom_c, dom_d, out, normal


def lemma61_argmax(geom: EdgeGeometry, j: int) -> float:
    """Lemma 6.1: max_i d(q_i,v_c) - d(q_i,v_d) via the <= 4 break positions
    (plus the two endpoints, which are also AP endpoints). Used in property
    tests to validate the vectorized classification."""
    x = geom.x
    a_c, a_d, b_c, b_d = geom.end_d[:, j]
    len_a = geom.len_a

    def d_c(xq):
        return np.minimum(xq + a_c, len_a - xq + b_c)

    def d_d(xq):
        return np.minimum(xq + a_d, len_a - xq + b_d)

    # break of d_c: x <= (len_a + b_c - a_c)/2 ; break of d_d likewise
    k = np.searchsorted(x, (len_a + b_c - a_c) / 2.0, side="right")
    k2 = np.searchsorted(x, (len_a + b_d - a_d) / 2.0, side="right")
    cand_idx = {0, len(x) - 1}
    for kk in (k, k2):
        for i in (kk - 1, kk):
            if 0 <= i < len(x):
                cand_idx.add(i)
    vals = [d_c(x[i]) - d_d(x[i]) for i in sorted(cand_idx)]
    return float(np.max(vals))


def add_arithmetic(
    diff2: np.ndarray, i0: np.ndarray, i1: np.ndarray, a: np.ndarray, s: np.ndarray
) -> None:
    """Accumulate arithmetic progressions onto a Δ² array, batched.

    Adds f(i) = a + (i - i0) * s for i in [i0, i1) (per element of the batch)
    such that cumsum(cumsum(diff2)) reproduces the sum of all progressions.
    diff2 must have length >= max(i1) + 2.
    """
    i0 = np.asarray(i0, np.int64)
    i1 = np.asarray(i1, np.int64)
    a = np.asarray(a, np.float64)
    s = np.asarray(s, np.float64)
    keep = i1 > i0
    i0, i1, a, s = i0[keep], i1[keep], a[keep], s[keep]
    if not len(i0):
        return
    endv = a + (i1 - 1 - i0) * s
    np.add.at(diff2, i0, a)
    np.add.at(diff2, i0 + 1, s - a)
    np.add.at(diff2, i1, -endv - s)
    np.add.at(diff2, i1 + 1, endv)


def recover_from_diff2(diff2: np.ndarray, l_a: int) -> np.ndarray:
    return np.cumsum(np.cumsum(diff2))[:l_a]


def dominated_sweep(F, index, ctx, dominated_work, ts) -> None:
    """Apply every deferred dominated edge's contribution to F [W, L].

    One batched ``dominated_moments`` sweep per side covers *all* windows
    (the rank searches and prefix gathers for the W windows share one pass —
    ``dominated_moments_multi`` when the index provides it, and the DRFS
    implementation includes unsealed pending events); only the O(1)-per-edge
    Δ² accumulation stays per window. ``dominated_work`` holds
    (geom, side, candidate-column) triples collected during planning.
    """
    ts_arr = np.asarray(ts, dtype=np.float64)
    W = len(ts_arr)
    if W == 0 or not dominated_work:
        return
    dm_multi = getattr(index, "dominated_moments_multi", None)
    for side in (0, 1):
        items = [(g, cols) for g, s, cols in dominated_work if s == side]
        if not items:
            continue
        all_edges = np.concatenate([g.cand[cols] for g, cols in items])
        offs = np.cumsum([0] + [len(c) for _, c in items])
        M_multi = (
            dm_multi(all_edges, ts_arr, side)
            if dm_multi is not None
            else np.stack([index.dominated_moments(all_edges, t, side) for t in ts_arr])
        )  # [W, n_edges, k_s]
        for w in range(W):
            M_all = M_multi[w]
            for (g, cols), lo, hi in zip(items, offs[:-1], offs[1:]):
                l_a = g.x.shape[0]
                diff2 = np.zeros(l_a + 2)
                direct = np.zeros(l_a)
                dominated_contribution(g, ctx, side, cols, M_all[lo:hi], diff2, direct)
                F[w, g.lix_base : g.lix_base + l_a] += (
                    recover_from_diff2(diff2, l_a) + direct
                )


def dominated_contribution(
    geom: EdgeGeometry,
    ctx: MomentContext,
    side: int,
    cols: np.ndarray,
    M: np.ndarray,
    diff2: np.ndarray,
    out_direct: np.ndarray,
) -> None:
    """Add the dominated edges' contributions for one query edge.

    side: 0 = dominated at v_c (distance d_c), 1 = at v_d.
    cols: candidate column indices (into geom.cand) that are dominated.
    M: [len(cols), k_s] spatial moment vectors from dominated_moments().
    Triangular kernels route through the Δ² array `diff2` (paper §6.2);
    other kernels accumulate directly into `out_direct` [l_a].
    """
    if len(cols) == 0:
        return
    ks, b_s = ctx.ks, ctx.b_s
    d = (geom.d_c if side == 0 else geom.d_d)[:, cols]  # [l_a, m]
    sig = geom.len_e[cols] / b_s
    l_a = geom.x.shape[0]
    is_triangular = getattr(ks, "name", "") == "triangular"
    if not is_triangular or l_a < 3:
        q = ks.q_vec(d / b_s, np.broadcast_to(sig[None, :], d.shape))  # [l_a, m, k_s]
        out_direct += np.einsum("lmk,mk->l", q, M)
        return
    # Triangular: Q_s(d) = [1 - d/b_s, -σ] → F_i = β + α d_i with
    #   α = -M0 / b_s,  β = M0 - σ M1  — two APs split at the lixel where the
    #   min() in d(q_i, v) flips from the v_a route to the v_b route.
    alpha = -M[:, 0] / b_s
    beta = M[:, 0] - sig * M[:, 1]
    # endpoint rows of geom.end_d: (a_c, a_d, b_c, b_d)
    A = geom.end_d[0 if side == 0 else 1][cols]
    B = geom.end_d[2 if side == 0 else 3][cols]
    x = geom.x
    # regular lixels are x[i] = (i + .5) g; the last one may be shorter.
    n_reg = l_a - 1
    step = x[1] - x[0] if l_a > 1 else 0.0
    thr = (geom.len_a + B - A) / 2.0  # route flips where x > thr
    k = np.searchsorted(x[:n_reg], thr).astype(np.int64) if n_reg else np.zeros(len(cols), np.int64)
    k = np.clip(k, 0, n_reg)
    # AP 1: i in [0, k): d = (x0 + A) + i*step
    add_arithmetic(diff2, np.zeros(len(cols), np.int64), k,
                   beta + alpha * (x[0] + A), alpha * step)
    # AP 2: i in [k, n_reg): d = (len_a - x_k + B) - (i-k)*step
    xk = x[np.minimum(k, n_reg - 1)] if n_reg else np.zeros(len(cols))
    add_arithmetic(diff2, k, np.full(len(cols), n_reg, np.int64),
                   beta + alpha * (geom.len_a - xk + B), -alpha * step)
    # last (possibly short) lixel: direct
    d_last = d[-1]
    out_direct[-1] += float(np.sum(beta + alpha * d_last))
