"""Shortest Path Sharing (SPS) baseline — the index-free method of §3.2/§8.2.

SPS shares the two endpoint shortest-path rows across all lixels of a query
edge (Rakshit et al. [41]) but performs *no aggregation*: every (lixel, event)
pair in range is evaluated directly. This is (a) the slowest baseline in the
paper's figures and (b) our bit-exact oracle: the indexed solutions (ADA /
RFS / DRFS-exact) must reproduce its output to float tolerance.

Distance semantics (Def. 3.4 + §3.2, also used by every index here):
  * event on a different edge e=(v_c,v_d):
        d(q,p) = min( d(q,v_c) + x_p ,  d(q,v_d) + (len_e - x_p) )
    with d(q,v_c) = min(x_q + d(v_a,v_c), len_a - x_q + d(v_b,v_c))   (SPS)
  * event on the query edge itself: d(q,p) = |x_q - x_p|
    (the standard network-KDE assumption that an edge is a locally
    shortest path; the paper uses the same convention).
Events contribute iff d <= b_s and |t - t_i| <= b_t (kernel domain [0,1]).
"""
from __future__ import annotations

import numpy as np

from .aggregation import MomentContext, window_rank_ranges
from .events import EdgeEvents
from .network import RoadNetwork
from .plan import EdgeGeometry

__all__ = ["sps_eval_edge", "sps_same_edge"]


def sps_eval_edge(
    geom: EdgeGeometry,
    ee: EdgeEvents,
    ctx: MomentContext,
    t: float,
    cand_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Direct evaluation of F over one query edge's lixels for window t.

    Returns float64 [l_a]. Used both as the SPS baseline and as the oracle.
    """
    l_a = geom.x.shape[0]
    out = np.zeros(l_a)
    b_s, b_t = ctx.b_s, ctx.b_t
    nc = geom.cand.shape[0]
    if nc:
        mask = np.ones(nc, bool) if cand_mask is None else np.asarray(cand_mask, bool)
        cols = np.nonzero(mask)[0]
        if len(cols):
            edges = geom.cand[cols]
            lo, mid, hi = window_rank_ranges(ee, edges, t, b_t)
            for j, e, rl, rh in zip(cols, edges, lo, hi):
                if rh <= rl:
                    continue
                base = int(ee.ptr[e])
                xp = ee.pos[base + rl : base + rh]
                te = ee.time[base + rl : base + rh]
                d = np.minimum(
                    geom.d_c[:, j : j + 1] + xp[None, :],
                    geom.d_d[:, j : j + 1] + (geom.len_e[j] - xp)[None, :],
                )
                w = np.where(d <= b_s, ctx.ks(np.minimum(d, b_s) / b_s), 0.0)
                wt = ctx.kt(np.abs(t - te) / b_t)
                out += w @ wt
    if geom.self_has_events:
        out += sps_same_edge(geom, ee, ctx, t)
    return out


def sps_same_edge(geom: EdgeGeometry, ee: EdgeEvents, ctx: MomentContext, t: float) -> np.ndarray:
    b_s, b_t = ctx.b_s, ctx.b_t
    (rl,), (_,), (rh,) = window_rank_ranges(ee, np.array([geom.a]), t, b_t)
    l_a = geom.x.shape[0]
    if rh <= rl:
        return np.zeros(l_a)
    base = int(ee.ptr[geom.a])
    xp = ee.pos[base + rl : base + rh]
    te = ee.time[base + rl : base + rh]
    d = np.abs(geom.x[:, None] - xp[None, :])
    w = np.where(d <= b_s, ctx.ks(np.minimum(d, b_s) / b_s), 0.0)
    wt = ctx.kt(np.abs(t - te) / b_t)
    return w @ wt
